"""Multi-device decode (``decode_shard``) and the logical-axis sharding
rules (``sharding``)."""
