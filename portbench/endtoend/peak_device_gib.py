"""``torch.cuda.max_memory_allocated()`` over the program's set-up and
window, in GiB; nothing on a run without a card."""


def read(w):
    return w['peak_bytes'] / 2**30 if w['peak_bytes'] else None
