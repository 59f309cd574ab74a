"""DSP ops: FIR banks, discriminator, carrier sync, RDS slicer, kernels."""
