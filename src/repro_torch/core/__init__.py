"""Core table: hashing, state layout, the combining transaction, the spec
and host-side invariant checks."""
