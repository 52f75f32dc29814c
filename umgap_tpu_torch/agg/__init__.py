"""Per-read aggregation on the device: dedup (K4) and the tail."""
