"""The port's optimizer: AdamW with schedules and clipping (``adamw``) and
int8 gradient compression with error feedback (``compress``)."""
