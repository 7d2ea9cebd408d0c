"""The blocked bloom filter's kernels (paper §IV: BloomFilter): ``ops``
holds the ``bloom_insert`` / ``bloom_query`` wrappers, their plain
versions and launch counters, ``ref`` the bit-view arithmetic they share."""
