"""Probes of the port, each the counterpart of the JAX package's file of the
same name under ``benchmarks/``; run one with ``python3 -m
oscillink_tpu_torch.benchmarks.<name>``."""
