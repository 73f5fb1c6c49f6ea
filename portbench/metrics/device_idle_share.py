"""device_idle_share (%): the share of the traced stretch in which no
kernel, copy or fill ran on the device."""


def read(run):
    t = run.trace
    if t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
