"""drain_ms.tuners: the multi-tuner CLI's ``drain`` phase
(``--trace-spans``, in the drain worker's thread) a segment: the wait on
the segment's event, every tuner's PCM write and its RDS framer's feeds.
The mean over the segments whose read began in the measured window,
before the profiler started recording."""


def read(records):
    sp = records.get("spans")
    if not sp or not sp["segments"]:
        return None
    return sum(sp.get("drain", [])) / sp["segments"]
