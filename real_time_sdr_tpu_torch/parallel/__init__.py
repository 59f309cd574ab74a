"""Channel-bank parallelism: many stations decoded at once on one card.

Port of ``real_time_sdr_tpu/parallel/`` (the single-device ``ChannelBank``;
sharding over devices is not ported yet)."""
