"""Mean recall@10 of every query answered in the window against the
reference's exact top 10 among the rows inside that request's filter."""


def read(w):
    return w['judge']['recall_at_10']
