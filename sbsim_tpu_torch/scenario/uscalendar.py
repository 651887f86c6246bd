"""US federal holiday calendar and workday logic.

The reference uses the `holidays` PyPI package
(smart_control/utils/conversion_utils.py:60-70); this is a self-contained
equivalent covering the US federal holidays with observed-date shifts
(Saturday -> preceding Friday, Sunday -> following Monday), which is what
`holidays.US()` yields for the years the simulator runs over.
"""

from __future__ import annotations

import datetime
import functools
from typing import Set


def _nth_weekday(year: int, month: int, weekday: int, n: int) -> datetime.date:
    """n-th (1-based) `weekday` (Mon=0) of a month."""
    d = datetime.date(year, month, 1)
    offset = (weekday - d.weekday()) % 7
    return d + datetime.timedelta(days=offset + 7 * (n - 1))


def _last_weekday(year: int, month: int, weekday: int) -> datetime.date:
    if month == 12:
        d = datetime.date(year, 12, 31)
    else:
        d = datetime.date(year, month + 1, 1) - datetime.timedelta(days=1)
    return d - datetime.timedelta(days=(d.weekday() - weekday) % 7)


def _with_observed(dates: Set[datetime.date], d: datetime.date) -> None:
    dates.add(d)
    if d.weekday() == 5:  # Saturday -> observed Friday
        dates.add(d - datetime.timedelta(days=1))
    elif d.weekday() == 6:  # Sunday -> observed Monday
        dates.add(d + datetime.timedelta(days=1))


@functools.lru_cache(maxsize=64)
def us_holidays(year: int) -> frozenset:
    """All US federal holiday dates (actual + observed) for one year."""
    dates: Set[datetime.date] = set()
    _with_observed(dates, datetime.date(year, 1, 1))  # New Year's Day
    # New Year's Day of the following year may be observed on Dec 31.
    nyd_next = datetime.date(year + 1, 1, 1)
    if nyd_next.weekday() == 5:
        dates.add(datetime.date(year, 12, 31))
    dates.add(_nth_weekday(year, 1, 0, 3))  # MLK Day
    dates.add(_nth_weekday(year, 2, 0, 3))  # Washington's Birthday
    dates.add(_last_weekday(year, 5, 0))  # Memorial Day
    if year >= 2021:
        _with_observed(dates, datetime.date(year, 6, 19))  # Juneteenth
    _with_observed(dates, datetime.date(year, 7, 4))  # Independence Day
    dates.add(_nth_weekday(year, 9, 0, 1))  # Labor Day
    dates.add(_nth_weekday(year, 10, 0, 2))  # Columbus Day
    _with_observed(dates, datetime.date(year, 11, 11))  # Veterans Day
    dates.add(_nth_weekday(year, 11, 3, 4))  # Thanksgiving
    _with_observed(dates, datetime.date(year, 12, 25))  # Christmas
    return frozenset(dates)


def is_us_holiday(d: datetime.date) -> bool:
    return d in us_holidays(d.year)


def is_work_day(d: datetime.date) -> bool:
    """Weekday and not a US holiday (conversion_utils.py:65-70)."""
    return d.weekday() < 5 and not is_us_holiday(d)
