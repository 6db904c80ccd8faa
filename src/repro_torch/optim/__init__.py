"""AdamW and PowerSGD (counterpart of ``repro.optim``)."""
