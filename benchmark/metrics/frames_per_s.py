"""Frames completed in the window, divided by the window's seconds."""


def read(rec):
    return rec.window.completed / rec.window.window_s
