"""Training: synthetic data, AdamW, checkpoints, the train step and the
fault-tolerant runner (counterpart of ``repro.train``)."""
