"""``transform_gsample_s``: every sample of every forward input and
every inverse output completed in the window, over the window's seconds
(host clock; the window runs from the first enqueue to the last
completion)."""


def read(reading):
    w = reading.window
    if w.completed == 0 or w.seconds <= 0:
        return None
    return 2 * reading.request_samples * w.completed / w.seconds / 1e9
