"""ChunkCache.misses at the window's close less at its opening (a
traced run's window: its first 15 s)."""


def read(run):
    return run.cache_misses
