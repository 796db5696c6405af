"""Ecosystem engines over the core query stack (SURVEY §2.11 analogs):
ANSI/ClickHouse-flavored SQL (CHYT analog) translating onto the native QL
engine, served through the query tracker's engine registry.

Own copy of the JAX package's `ecosystem/`."""
