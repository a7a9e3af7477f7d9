"""Health sentinels and the typed errors the pipelined stepper raises."""
