"""The benchmark's general parts: the registry that finds a cell's files by
name, the frame generator, the trace reader, the roofline table and the
comparison that decides ``correct``."""
