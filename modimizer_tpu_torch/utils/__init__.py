from .glibc_random import GlibcRandom
from .timers import Timer
