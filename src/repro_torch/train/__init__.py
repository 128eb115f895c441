"""Deep Potential training: AdamW, the energy+force loss, checkpoints."""
