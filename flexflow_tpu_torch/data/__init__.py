"""Data loading: host numpy batches staged onto the device."""
