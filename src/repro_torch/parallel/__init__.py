"""Multi-device decode: the sharded executor (``decode_shard``)."""
