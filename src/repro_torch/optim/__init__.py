"""Optimization of the port: AdamW (``adamw``), LR schedules
(``schedule``) and gradient compression with error feedback, whose int8
quantizer the checkpoint's Recoil codec also uses (``compress``)."""
