"""Parallel forms of the receiver: many stations at once and one long
capture cut in time, on one card or over several.

Port of ``real_time_sdr_tpu/parallel/``: ``channel`` (the channel bank,
over a list of devices), ``wideband`` (station-sharded wideband serving),
``time_shard`` (exact and warm-up time sharding; shards are rows of the
batch) and ``distributed`` (``torch.distributed`` helpers)."""
