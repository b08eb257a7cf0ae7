"""Synchronised host ms of ``Committee.attack_model`` (the noise bank,
with the one-pixel DE where the bank has it) per pair in the window."""


def read(run):
    c = run.window.counters
    return None if not c["pairs"] else 1e3 * c["attack_s"] / c["pairs"]
