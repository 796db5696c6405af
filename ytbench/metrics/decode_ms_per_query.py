"""Host seconds decoding missed chunks per query, in ms: Σ decode_time /
ok queries. decode_time is the decode phase of `deserialize_chunk` (the
blocks inflated, checked, varint and delta decoded and padded on the
codec pool, the `chunk.decode` span), summed over every thread that
staged chunks for the query (QueryStatistics MISS_FIELDS), so it may
exceed the query's wall.

The window's queries are the last `attempted` select records of the
program's workload log, as `ytbench/miss_path.py` reads them. None where
the log holds fewer or its records carry no miss-path fields."""

from ytbench.miss_path import window_stages


def read(run):
    stages = window_stages(run, ("decode_time",))
    if stages is None:
        return None
    return sum(s["decode_time"] for s in stages) / len(stages) * 1e3
