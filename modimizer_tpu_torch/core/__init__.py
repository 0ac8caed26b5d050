from .seqhash import Seqhash
from .modset import Modset
