"""submit_ms.tuners: the multi-tuner CLI's ``submit`` phase
(``--trace-spans``) a segment: any wait on the drain worker at the bound,
every tuner's ``[tail | segment]`` staged into one pinned slot, the
upload, the graph replay and the fetch. The mean over the segments whose
read began in the measured window, before the profiler started
recording."""


def read(records):
    sp = records.get("spans")
    if not sp or not sp["segments"]:
        return None
    return sum(sp.get("submit", [])) / sp["segments"]
