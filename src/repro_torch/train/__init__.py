"""Training of the port: AdamW, the train step, the checkpointed loop."""
