"""AdamW, the train steps and the carry-across of reference state."""
