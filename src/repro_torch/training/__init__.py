"""Training of the port: AdamW, int8 gradient compression, the train and
serve steps, checkpoints and the preemption-safe trainer."""
