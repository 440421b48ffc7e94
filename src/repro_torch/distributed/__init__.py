"""Hardware constants for the port's performance model."""
