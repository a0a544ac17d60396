"""Roofline terms of a step (counterpart of `repro.roofline`): the hardware
table and the three terms (`analysis`), from the work a step's ops do as
counted by a dispatch mode (`counter`) in place of the reference's XLA HLO
walker."""
