"""Execution: parameter init and the executor's serving programs."""
