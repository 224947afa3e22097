from . import io, state
from .params import Obstacles, Params, reynolds_number
