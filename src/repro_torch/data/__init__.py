"""Training data of the port: synthetic and Recoil-coded token shards
(``pipeline``)."""
