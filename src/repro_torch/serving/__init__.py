"""repro_torch.serving — the table as a service: ``elastic``, the port of
``repro.serving.elastic`` (P owner-routed single-value shards behind
per-shard bloom filters, with compaction, resharding and snapshots)."""
