"""google.protobuf.Timestamp (timestamp.proto beside this file), with the
conversions of protobuf's well-known type."""

from __future__ import annotations

import calendar
import datetime

from sbsim_tpu_torch.proto._message import INT32, INT64, Field, message_type

_NANOS_PER_SECOND = 1_000_000_000
_NANOS_PER_MICROSECOND = 1000
_EPOCH_NAIVE = datetime.datetime(1970, 1, 1)
_EPOCH_AWARE = datetime.datetime(1970, 1, 1, tzinfo=datetime.timezone.utc)

_Timestamp = message_type("Timestamp", "google.protobuf.Timestamp", [
    Field("seconds", 1, INT64),
    Field("nanos", 2, INT32),
])


class Timestamp(_Timestamp):
    __slots__ = ()

    def FromNanoseconds(self, nanos: int) -> None:
        self.seconds, self.nanos = divmod(int(nanos), _NANOS_PER_SECOND)

    def ToNanoseconds(self) -> int:
        return self.seconds * _NANOS_PER_SECOND + self.nanos

    def FromDatetime(self, dt: datetime.datetime) -> None:
        """A naive datetime is taken as UTC; an aware one is converted."""
        self.seconds = calendar.timegm(dt.utctimetuple())
        self.nanos = dt.microsecond * _NANOS_PER_MICROSECOND

    def ToDatetime(self, tzinfo=None) -> datetime.datetime:
        """Naive UTC without `tzinfo`, else aware in that zone; nanoseconds
        are cut to microseconds toward zero."""
        delta = datetime.timedelta(seconds=self.seconds,
                                   microseconds=self.nanos // _NANOS_PER_MICROSECOND)
        if tzinfo is None:
            return _EPOCH_NAIVE + delta
        return (_EPOCH_AWARE + delta).astimezone(tzinfo)
