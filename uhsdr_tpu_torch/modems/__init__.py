"""Digital-mode decoders (CW, PSK, RTTY), their text tiers and the decoder tap."""
