"""Plain PyTorch device ops and the integrator kernel's wrapper."""
