"""Host-side helpers: the loader of the repo's C++ frame scanner."""
