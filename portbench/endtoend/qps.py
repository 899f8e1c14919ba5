"""Queries completed in the window over the window's length."""


def read(w):
    return w['queries'] / w['seconds']
