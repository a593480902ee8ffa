"""Host I/O: IQ capture ingest and audio sinks."""
