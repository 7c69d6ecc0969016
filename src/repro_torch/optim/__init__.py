"""Optimization helpers of the port: the per-block int8 quantizer
(``compress``) that the checkpoint's Recoil codec uses."""
