"""Backend selection for the solver's device path."""
