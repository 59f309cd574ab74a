"""skew_wait_ms.tuners: the multi-tuner CLI's ``skew_wait`` span
(``--trace-spans``) a segment: inside the serving thread's wait on its
inputs (``read_wait``), from the first tuner's segment complete to the
last's. The mean over the segments whose read began in the measured
window, before the profiler started recording."""


def read(records):
    sp = records.get("spans")
    if not sp or not sp["segments"]:
        return None
    return sum(sp.get("skew_wait", [])) / sp["segments"]
