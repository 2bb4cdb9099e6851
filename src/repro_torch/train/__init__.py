"""Training (port of ``repro.train``): AdamW with master weights and
ZeRO-1 state sharding (``optimizer.py``), the train step with gradient
accumulation, on one device or a live mesh (``train_step.py``), and GPipe
over a ``stage`` mesh axis (``pipeline.py``)."""
