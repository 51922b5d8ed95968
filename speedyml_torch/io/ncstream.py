"""O(1)-append NetCDF record writer (classic/CDF-2 format). The port's own
copy of speedyml/io/ncstream.py: host-side, numpy and struct only.

scipy's `netcdf_file` keeps every record variable's data in host memory and
rewrites the ENTIRE file on each flush: appending T records costs O(T^2) in
both memcpy (ndarray.resize per append) and file I/O — fine for a 98-day
run, catastrophic for the 10-year coupled runs this model targets
(14,560 records x ~2.4 MB/record).

This module appends in O(1) using the NetCDF-3 record-slab layout directly
(the same property the reference's per-step writer relies on via the
NetCDF-C library, mod_io.f90:32-849): all record variables' blocks for
record t live contiguously at `begin_v + t * recsize`, and the only header
field that changes is `numrecs` (bytes 4-8). The flow:

  1. scipy writes the header + non-record data once (0 records);
  2. `_parse_header` reads the dimension/variable tables straight from the
     file (scipy's write-mode `_begin`/`_vsize` internals are unreliable at
     0 records) and PATCHES the record variables' vsize/begin fields, which
     scipy leaves as 0/duplicated in an empty file;
  3. `append_record` seeks and writes one big-endian block per variable;
  4. `flush` patches numrecs so readers (scipy included, verified by test)
     see everything written so far — a crashed run keeps its records.
"""

from __future__ import annotations

import struct

import numpy as np

# external size per nc_type (NC_BYTE..NC_DOUBLE)
_NC_SIZES = {1: 1, 2: 1, 3: 2, 4: 4, 5: 4, 6: 8}
_NC_DTYPE = {1: ">i1", 2: "S1", 3: ">i2", 4: ">i4", 5: ">f4", 6: ">f8"}


def _parse_header(path: str):
    """Parse dims + variable table of a classic/CDF-2 NetCDF file; returns
    (version, {name: {isrec, shape, nct, vsize, begin, vsize_off,
    begin_off}}, record-var names in slab order)."""
    with open(path, "rb") as f:
        raw = f.read(1 << 20)            # headers are tiny
    assert raw[:3] == b"CDF", "not a NetCDF classic file"
    ver = raw[3]
    off = [4]

    def i4():
        v = struct.unpack(">i", raw[off[0]:off[0] + 4])[0]
        off[0] += 4
        return v

    def i8():
        v = struct.unpack(">q", raw[off[0]:off[0] + 8])[0]
        off[0] += 8
        return v

    def name():
        n = i4()
        s = raw[off[0]:off[0] + n]
        off[0] += (n + 3) // 4 * 4
        return s.decode("latin1")

    def skip_atts():
        _tag, na = i4(), i4()
        for _ in range(na):
            name()
            t = i4()
            n = i4()
            off[0] += (n * _NC_SIZES[t] + 3) // 4 * 4

    i4()                                  # numrecs (patched separately)
    _tag, nd = i4(), i4()
    dims = []
    for _ in range(nd):
        dims.append((name(), i4()))
    skip_atts()                           # global attributes
    _tag, nv = i4(), i4()
    unlim = {i for i, (_n, sz) in enumerate(dims) if sz == 0}
    out = {}
    order = []
    for _ in range(nv):
        nm = name()
        ndims = i4()
        dimids = [i4() for _ in range(ndims)]
        skip_atts()
        nct = i4()
        vsize_off = off[0]
        vsize = i4()
        begin_off = off[0]
        begin = i8() if ver == 2 else i4()
        isrec = bool(dimids) and dimids[0] in unlim
        shape = tuple(dims[d][1] for d in dimids)
        out[nm] = dict(isrec=isrec, shape=shape, nct=nct, vsize=vsize,
                       begin=begin, vsize_off=vsize_off,
                       begin_off=begin_off)
        order.append(nm)
    recvars = [nm for nm in order if out[nm]["isrec"]]
    return ver, out, recvars


class RecordAppender:
    """Open a freshly-created (0-record) NetCDF file for O(1) appends.

    Patches the record variables' vsize/begin header fields (see module
    docstring), then exposes `write(name, t, array)` + `set_numrecs(n)`.
    """

    def __init__(self, path: str):
        self.path = path
        ver, vars_, recvars = _parse_header(path)
        self._vars = vars_
        self.recvars = recvars
        assert recvars, "no record variables to append"

        def block_bytes(v):
            n = int(np.prod(v["shape"][1:], dtype=np.int64)) \
                if len(v["shape"]) > 1 else 1
            return n * _NC_SIZES[v["nct"]]

        base = min(vars_[nm]["begin"] for nm in recvars)
        self._fp = open(path, "r+b")
        cur = base
        for nm in recvars:
            v = vars_[nm]
            vs = (block_bytes(v) + 3) // 4 * 4
            self._fp.seek(v["vsize_off"])
            self._fp.write(struct.pack(">i", vs))
            self._fp.seek(v["begin_off"])
            self._fp.write(struct.pack(">q" if ver == 2 else ">i", cur))
            v["vsize"], v["begin"] = vs, cur
            v["_block"] = block_bytes(v)
            cur += vs
        self.recsize = (cur - base if len(recvars) > 1
                        else block_bytes(vars_[recvars[0]]))
        self._numrecs = 0

    def write(self, name: str, t: int, arr) -> None:
        v = self._vars[name]
        a = np.ascontiguousarray(arr, dtype=_NC_DTYPE[v["nct"]])
        assert a.nbytes == v["_block"], \
            f"{name}: {a.nbytes} bytes != record block {v['_block']}"
        self._fp.seek(v["begin"] + t * self.recsize)
        self._fp.write(a.tobytes())
        if t + 1 > self._numrecs:
            self._numrecs = t + 1

    def flush(self) -> None:
        self._fp.seek(4)
        self._fp.write(struct.pack(">i", self._numrecs))
        self._fp.flush()

    def close(self) -> None:
        if self._fp.closed:
            return
        self.flush()
        self._fp.close()
