"""Checkpointing of the port: ``manager.CheckpointManager``, with a
Recoil-coded payload on the card's ingest and walk kernels."""
