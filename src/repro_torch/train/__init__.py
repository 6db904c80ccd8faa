"""Train step, trainer and LoRA (counterpart of ``repro.train``)."""
