"""The hybrid chunk's 6-h window as one captured CUDA graph
(speedyml_torch.hybrid.fastloop._WindowGraph), at the full T30L8 grid with
a narrow reservoir (n = n_in, two shifts, a seeded small readout).

On the CPU the window runs eagerly: no graph, no capture, no replay
counted. On the card (`cuda`-marked) two chunks replayed from the graph
give bitwise what the eager window gives, dry and with full physics.

This file imports neither JAX nor another test module, so that it runs
on a card even where the name `tests` resolves to another installed
package.
"""

import tempfile

import numpy as np
import pytest
import torch

from speedyml_torch import (ModelConfig, ModelDate, ReservoirConfig,
                            ScanHybridRunner)
from speedyml_torch.domain.decomposition import build_layout, pack_global
from speedyml_torch.domain.standardize import Standardizer
from speedyml_torch.hybrid.experiment import HybridModel
from speedyml_torch.hybrid.fastloop import ChunkResult
from speedyml_torch.hybrid.state_io import extract
from speedyml_torch.io.synthetic_boundary import write_synthetic_boundary
from speedyml_torch.model import Speedy
from speedyml_torch.reservoir.esn import EsnParams
from speedyml_torch.utils import diag

torch.set_num_threads(1)

DATE = (1982, 1, 31, 0)


def _speedy(dtype, device):
    """A SPEEDY on stand-in files at its start state."""
    sp = Speedy(ModelConfig(dtype=dtype),
                write_synthetic_boundary(tempfile.mkdtemp(), 4),
                device=device)
    sp.initialize(1982, 1)
    return sp


def _hybrid_parts(sp):
    """A hybrid model over the 1152 regions of `sp` at its start state, on
    its device (n = n_in, two shifts, a seeded small readout), and the
    carry (x, atmo, logp, pr) to start from."""
    L = build_layout(radang_deg=np.degrees(np.asarray(sp.dy.tables.radang)))
    gs = extract(sp.dy, sp.state)
    atmo = torch.stack([gs.t, gs.u, gs.v,
                        torch.clamp(gs.q, min=1e-6)]).float().cpu()
    logp = gs.logp.float().cpu()
    gv0 = pack_global(L, atmo, logp, torch.zeros_like(logp),
                      torch.full_like(logp, 280.0), torch.zeros_like(logp))
    idx, tidx = L.maps("cpu")
    g = torch.Generator().manual_seed(12)
    n, shifts = L.n_in, (1, 2)
    on = {k: v.to(sp.dy.device) for k, v in dict(
        in_mean=gv0[idx], in_std=torch.full((L.R, L.n_in), 5.0),
        out_mean=gv0[tidx], out_std=torch.ones(L.R, L.n_out),
        a_idx=((torch.arange(n)[:, None] + torch.tensor(shifts)) % n)[
            None].expand(L.R, n, len(shifts)),
        a_val=0.3 * torch.randn((L.R, n, len(shifts)), generator=g),
        win=0.5 * torch.randn((L.R, n), generator=g),
        wout=0.003 * torch.randn((L.R, L.n_out, n + L.n_out), generator=g),
        node_map=torch.arange(n), x=0.1 * torch.randn((L.R, n), generator=g),
        atmo=atmo, logp=logp, pr=torch.zeros_like(logp)).items()}
    stz = Standardizer(*(on[k] for k in Standardizer._fields))
    params = EsnParams(a_idx=on["a_idx"], a_val=on["a_val"], win=on["win"],
                       wout=on["wout"], node_map=on["node_map"], leakage=1.0,
                       a_shift=shifts)
    hm = HybridModel(layout=L, params=params, stz=stz, rcfg=ReservoirConfig())
    return hm, tuple(on[k] for k in ("x", "atmo", "logp", "pr"))


class _Eager(ScanHybridRunner):
    """The chunked loop with the window launched op by op on any device."""

    def _model_gv(self, atmo, logp, sst, ss, ti, xs, k):
        return self._window_eager(atmo, logp, sst, ss, ti, xs, k)


def _traced(fn):
    """fn()'s result and the spans it recorded."""
    diag.clear()
    try:
        with diag.tracing():
            out = fn()
        return out, diag.spans()
    finally:
        diag.clear()


def test_cpu_window_runs_eager_and_counts_no_graph():
    """On the CPU the hybrid chunk builds no graph: no capture, no replay
    counted, and its outputs are bitwise those of the eager window."""
    sp = _speedy("float64", "cpu")
    hm, carry = _hybrid_parts(sp)
    K, chunks = 2, 2
    runner = ScanHybridRunner(hm, sp, physics=False, chunk=K)
    out, recs = _traced(lambda: runner.run(*carry, ModelDate(*DATE),
                                           K * chunks, stream=True))
    eager = _Eager(hm, sp, physics=False, chunk=K).run(
        *carry, ModelDate(*DATE), K * chunks, stream=True)
    assert out["steps_done"] == eager["steps_done"] == K * chunks
    for key in ("x", "atmo_end", "logp_end", "precip_t"):
        assert torch.equal(out[key], eager[key]), key
    assert runner._graph is None and runner._captures == 0
    windows = [r for r in recs if r["name"] == "fastloop.window"]
    assert len(windows) == K * chunks
    assert not any("graphed" in r["counts"] or "captures" in r["counts"]
                   for r in recs)
@pytest.mark.cuda
@pytest.mark.parametrize("physics", [False, True], ids=["dry", "physics"])
def test_window_graph_replays_the_eager_window(physics, monkeypatch):
    """On the card, two hybrid chunks of K = 3 steps with the window
    replayed from its CUDA graph give the stacks, carry and flags of the
    eager window bitwise; the model supervector that hm.step reads at step
    k is step k's, though every step's replay writes the same buffer; the
    graph is captured once, in the first chunk, and replayed every step."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    sp = _speedy("float32", "cuda")
    hm, carry = _hybrid_parts(sp)
    K = 3
    step = hm.step
    kept = {}

    def run(runner, name):
        seen, chunks = [], []
        chunk = runner.run_chunk

        def run_chunk(*args):
            chunks.append(chunk(*args))
            return chunks[-1]

        def watched(x, gv, model_gv):
            seen.append((model_gv.data_ptr(), model_gv.clone()))
            return step(x, gv, model_gv)
        runner.run_chunk = run_chunk
        monkeypatch.setattr(hm, "step", watched)
        out = runner.run(*carry, ModelDate(*DATE), 2 * K, stream=True)
        torch.cuda.synchronize()
        assert out["steps_done"] == 2 * K
        kept[name] = seen, chunks

    run(_Eager(hm, sp, physics=physics, chunk=K), "eager")
    graphed = ScanHybridRunner(hm, sp, physics=physics, chunk=K)
    _, recs = _traced(lambda: run(graphed, "graph"))
    (seen_g, got), (seen_e, want) = kept["graph"], kept["eager"]
    assert len(got) == len(want) == 2
    for g, e in zip(got, want):
        for key in ChunkResult._fields:
            assert torch.equal(getattr(g, key), getattr(e, key)), key
        assert bool(g.safe_st.all())
    # one buffer, read by every step's hm.step, held that step's window
    assert len({p for p, _ in seen_g}) == 1 and len(seen_g) == 2 * K
    for (_, g), (_, e) in zip(seen_g, seen_e):
        assert torch.equal(g, e)
    assert not torch.equal(seen_g[0][1], seen_g[1][1])
    assert graphed._captures == 1
    chunks = [r for r in recs if r["name"] == "fastloop.chunk"]
    assert [r["counts"].get("captures", 0) for r in chunks] == [1, 0]
    windows = [r for r in recs if r["name"] == "fastloop.window"]
    assert len(windows) == 2 * K
    assert all(r["counts"] == {"graphed": 1} for r in windows)
