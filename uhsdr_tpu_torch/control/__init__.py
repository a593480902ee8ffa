"""Control plane: CAT, the radio model, meters, oscillators, calibration,
self-test and the live radio server."""
