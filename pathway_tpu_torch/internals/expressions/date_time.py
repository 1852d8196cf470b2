"""``expr.dt.*`` namespace (reference: python/pathway/internals/expressions/date_time.py).

Datetimes are python ``datetime.datetime`` / numpy datetime64 values on the
host; these methods never hit the device path.
"""

from __future__ import annotations

import datetime

from .. import dtype as dt
from ..expression import ColumnExpression, MethodCallExpression, smart_coerce


def _m(name, args, fun, return_type):
    return MethodCallExpression(name, args, fun, return_type)


def _to_dt(value):
    import numpy as np

    if isinstance(value, np.datetime64):
        ts = (value - np.datetime64(0, "s")) / np.timedelta64(1, "s")
        return datetime.datetime.utcfromtimestamp(float(ts))
    return value


class DateTimeNamespace:
    def __init__(self, expr: ColumnExpression):
        self._e = expr

    def year(self):
        return _m("dt.year", (self._e,), lambda d: _to_dt(d).year, dt.INT)

    def month(self):
        return _m("dt.month", (self._e,), lambda d: _to_dt(d).month, dt.INT)

    def day(self):
        return _m("dt.day", (self._e,), lambda d: _to_dt(d).day, dt.INT)

    def hour(self):
        return _m("dt.hour", (self._e,), lambda d: _to_dt(d).hour, dt.INT)

    def minute(self):
        return _m("dt.minute", (self._e,), lambda d: _to_dt(d).minute, dt.INT)

    def second(self):
        return _m("dt.second", (self._e,), lambda d: _to_dt(d).second, dt.INT)

    def millisecond(self):
        return _m(
            "dt.millisecond", (self._e,), lambda d: _to_dt(d).microsecond // 1000, dt.INT
        )

    def microsecond(self):
        return _m("dt.microsecond", (self._e,), lambda d: _to_dt(d).microsecond, dt.INT)

    def nanosecond(self):
        return _m(
            "dt.nanosecond", (self._e,), lambda d: _to_dt(d).microsecond * 1000, dt.INT
        )

    def timestamp(self, unit: str = "s"):
        div = {"ns": 1e-9, "us": 1e-6, "ms": 1e-3, "s": 1.0}[unit]
        return _m(
            "dt.timestamp",
            (self._e,),
            lambda d: _to_dt(d).timestamp() / div,
            dt.FLOAT,
        )

    def strftime(self, fmt: str):
        return _m("dt.strftime", (self._e,), lambda d: _to_dt(d).strftime(fmt), dt.STR)

    def strptime(self, fmt: str, contains_timezone: bool = False):
        return _m(
            "dt.strptime",
            (self._e,),
            lambda s: datetime.datetime.strptime(s, fmt),
            dt.DATE_TIME_UTC if contains_timezone else dt.DATE_TIME_NAIVE,
        )

    def to_utc(self, from_timezone: str):
        import zoneinfo

        tz = zoneinfo.ZoneInfo(from_timezone)

        def conv(d):
            d = _to_dt(d)
            return d.replace(tzinfo=tz).astimezone(datetime.timezone.utc)

        return _m("dt.to_utc", (self._e,), conv, dt.DATE_TIME_UTC)

    def to_naive_in_timezone(self, timezone: str):
        import zoneinfo

        tz = zoneinfo.ZoneInfo(timezone)

        def conv(d):
            d = _to_dt(d)
            return d.astimezone(tz).replace(tzinfo=None)

        return _m("dt.to_naive_in_timezone", (self._e,), conv, dt.DATE_TIME_NAIVE)

    def from_timestamp(self, unit: str = "s"):
        mul = {"ns": 1e-9, "us": 1e-6, "ms": 1e-3, "s": 1.0}[unit]
        return _m(
            "dt.from_timestamp",
            (self._e,),
            lambda x: datetime.datetime.utcfromtimestamp(x * mul),
            dt.DATE_TIME_NAIVE,
        )

    def round(self, duration):
        def conv(d):
            d = _to_dt(d)
            total = d.timestamp()
            dur = duration.total_seconds() if isinstance(duration, datetime.timedelta) else duration
            return datetime.datetime.utcfromtimestamp(round(total / dur) * dur)

        return _m("dt.round", (self._e,), conv, dt.DATE_TIME_NAIVE)

    def floor(self, duration):
        import math

        def conv(d):
            d = _to_dt(d)
            total = d.timestamp()
            dur = duration.total_seconds() if isinstance(duration, datetime.timedelta) else duration
            return datetime.datetime.utcfromtimestamp(math.floor(total / dur) * dur)

        return _m("dt.floor", (self._e,), conv, dt.DATE_TIME_NAIVE)
