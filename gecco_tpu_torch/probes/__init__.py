"""Measurements of kernel designs that were tried and not adopted, kept so
that their numbers can be taken again on the card."""
