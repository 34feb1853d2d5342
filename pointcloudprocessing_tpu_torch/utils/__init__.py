"""Host-side helpers: the loader of the repo's C++ runtime helpers and the
profiling hooks."""
