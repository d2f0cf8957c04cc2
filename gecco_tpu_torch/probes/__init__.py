"""Measurements beside ``chip_smoke.py``: kernel designs that were tried
and not adopted, kept so that their numbers can be taken again on the card,
and a pass-by-pass check of the pool backward's Hopper body."""
