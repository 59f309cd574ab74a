"""cli_block_ms.listeners: the listeners' own ``--stats`` time per block
(host clock, the wait on the source left out), averaged over every
listener's blocks in the measured window; in a traced run, over those
before the profiler starts recording."""


def read(records):
    ms = records.get("block_ms")
    return sum(ms) / len(ms) if ms else None
