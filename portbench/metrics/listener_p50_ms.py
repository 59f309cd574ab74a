"""listener_p50_ms: the median of the listeners' per-block latencies, the
samples of ``listener_p95_ms`` (PCM arrival at the reader less the time
the block's last byte was due from the tuner); in a traced run, of the
blocks due before the profiler starts recording, whose overhead alone
would push the listeners past their capacity."""

import statistics


def read(records):
    lat = records.get("latency_ms")
    return statistics.median(lat) if lat else None
