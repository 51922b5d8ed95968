"""Calendars (the port's own copy of what it calls from
speedyml/core/calendar.py).

1. `ModelDate`: the dycore's 365-day calendar with the reference's leap-day
   quirk (mod_date.f90:newdate — Feb 29 exists when iyear%4==0 but tyear is
   always computed on the 365-day year).
2. Hour-resolution calendar arithmetic from a 1981-01-01 epoch for the
   ML/hybrid side (reference: src/mod_calendar.f90).
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


def is_leap(year: int) -> bool:
    return year % 4 == 0 and (year % 100 != 0 or year % 400 == 0)


def days_in_month(year: int, month: int) -> int:
    if month == 2 and is_leap(year):
        return 29
    return _NDAYS[month - 1]


EPOCH_YEAR = 1981


def hours_since_epoch(year: int, month: int, day: int, hour: int) -> int:
    """numof_hours from the 1981-01-01 00 epoch (mod_calendar.f90:69-120);
    leap-year aware."""
    days = 0
    if year >= EPOCH_YEAR:
        for y in range(EPOCH_YEAR, year):
            days += 366 if is_leap(y) else 365
    else:
        for y in range(year, EPOCH_YEAR):
            days -= 366 if is_leap(y) else 365
    for m in range(1, month):
        days += days_in_month(year, m)
    days += day - 1
    return days * 24 + hour


def datetime_from_hours(hours: int):
    """Inverse of hours_since_epoch: (year, month, day, hour)."""
    days, hour = divmod(hours, 24)
    year = EPOCH_YEAR
    while True:
        ylen = 366 if is_leap(year) else 365
        if days >= ylen:
            days -= ylen
            year += 1
        elif days < 0:
            year -= 1
            days += 366 if is_leap(year) else 365
        else:
            break
    month = 1
    while days >= days_in_month(year, month):
        days -= days_in_month(year, month)
        month += 1
    return year, month, days + 1, hour


def hours_into_year(year: int, month: int, day: int, hour: int) -> int:
    """numof_hours_into_year (mod_calendar.f90:122-168)."""
    return hours_since_epoch(year, month, day, hour) - hours_since_epoch(
        year, 1, 1, 0)


def prediction_markers(start: "ModelDate", count: int,
                       stride_hours: int) -> list:
    """Forecast start dates spaced stride_hours apart
    (distribute_prediction_marker, mpires.f90:928-948)."""
    h0 = hours_since_epoch(start.iyear, start.imonth, start.iday, start.ihour)
    out = []
    for i in range(count):
        y, m, d, h = datetime_from_hours(h0 + i * stride_hours)
        out.append(ModelDate(iyear=y, imonth=m, iday=d, ihour=h))
    return out
