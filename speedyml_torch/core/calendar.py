"""The dycore's calendar (the port's own copy of `ModelDate` from
speedyml/core/calendar.py).

`ModelDate`: the 365-day calendar with the reference's leap-day quirk
(mod_date.f90:newdate — Feb 29 exists when iyear%4==0 but tyear is always
computed on the 365-day year).
"""

from __future__ import annotations

import dataclasses

_NDAYS = [31, 28, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31]
_CUMDAYS = [0]
for _n in _NDAYS[:-1]:
    _CUMDAYS.append(_CUMDAYS[-1] + _n)


@dataclasses.dataclass
class ModelDate:
    """Date state for the dycore (1-based month/day, matching mod_date)."""

    iyear: int
    imonth: int
    iday: int = 1
    ihour: int = 0

    def advance_day(self):
        """newdate(1) (mod_date.f90:56-80)."""
        self.iday += 1
        if self.iyear % 4 == 0 and self.imonth == 2:
            if self.iday > 29:
                self.iday = 1
                self.imonth += 1
        else:
            if self.iday > _NDAYS[self.imonth - 1]:
                self.iday = 1
                self.imonth += 1
        if self.imonth > 12:
            self.imonth = 1
            self.iyear += 1

    def advance_hours(self, n: int):
        """Advance by n hours, rolling days via advance_day."""
        self.ihour += n
        while self.ihour >= 24:
            self.ihour -= 24
            self.advance_day()

    @property
    def tmonth(self) -> float:
        return (self.iday - 0.5) / _NDAYS[self.imonth - 1]

    @property
    def tyear(self) -> float:
        return (_CUMDAYS[self.imonth - 1] + self.iday - 0.5) / 365.0
