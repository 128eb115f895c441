"""Training: AdamW, the DP energy+force loss, the LM train and serve steps,
checkpoints."""
