"""The LM decoder: shared layers, attention, MoE and the model."""
