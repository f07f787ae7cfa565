"""The LM training substrate: AdamW, gradient compression, checkpoints and
the train loop (the reference package's ``train/``)."""
