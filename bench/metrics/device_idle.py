"""Share of the traced window in which no kernel or copy ran on the card
(the union of the device events' intervals), in %."""


def read(rec):
    if not rec["window_s"] or rec["device"]["events"] == 0:
        return None
    return 100.0 * (1.0 - rec["device"]["busy_s"] / rec["window_s"])
