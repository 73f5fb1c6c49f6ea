"""BA601 fixture: emit sites against the port's record families
(parsed, never run)."""

SCHEMA_VERSION = 1


class _Sink:
    def emit(self, rec):
        return rec


def unknown_family(sink):
    sink.emit({"event": "kernel_launch", "v": 1})  # expect: BA601


def missing_required_keys(sink):
    sink.emit(
        {  # expect: BA601
            "event": "recovery",
            "v": SCHEMA_VERSION,
            "action": "resume",
        }
    )


def complete_site(sink):
    sink.emit({"event": "shed", "v": SCHEMA_VERSION, "tier": 1, "prev_tier": 0,
               "queue_depth": 9})


def spread_site(sink, extra):
    sink.emit({"event": "flight_span", "v": SCHEMA_VERSION, **extra})


# Negative: a filter dict, not an emit site.
RECOVERY_FILTER = {"event": "recovery"}
