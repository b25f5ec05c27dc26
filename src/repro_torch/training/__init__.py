"""AdamW, the train steps (per step, unrolled, data-parallel), int8
gradient compression and the carry-across of reference state."""
