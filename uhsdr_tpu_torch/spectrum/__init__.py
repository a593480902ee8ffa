"""The spectrum scope: averaged spectra, dBm, SNAP and the waterfall."""
