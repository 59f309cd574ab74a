"""cli_segment_ms: the wideband CLI's own ``--stats`` time per segment
(host clock: the upload, the dispatch, and the drain of the segments that
leave the pipeline, the pipe read left out), averaged over the segments
of the measured window; in a traced run, over those before the profiler
starts recording."""


def read(records):
    ms = records.get("segment_ms")
    return sum(ms) / len(ms) if ms else None
