# effectively +inf for masked-out scores; compared in float32, where it is
# 3.4e38 rounded to the nearest float32
BIG = 3.4e38

__all__ = ['BIG']
