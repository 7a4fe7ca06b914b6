from .config import SHAPES, ModelConfig, ShapeCell
from .registry import build_model
from .transformer import LM
