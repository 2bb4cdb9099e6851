"""Training (port of ``repro.train``): AdamW with master weights
(``optimizer.py``) and the train step with gradient accumulation
(``train_step.py``)."""
