from .options import AdjustmentOptions
from .simultaneous import adjust_simultaneous, AdjustmentResult
