"""Roofline terms of a step on the H100 (`hlo_costs`), the dry-run's
tables (`report`) and a before/after comparison (`compare`)."""
