"""Receiver chains: (state, u8 IQ rows) -> (state, outputs) modules."""
