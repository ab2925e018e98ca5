from .contract import ENDIANNESS, levelize, validate_circuit_dict
from . import gates, library

__all__ = ["ENDIANNESS", "levelize", "validate_circuit_dict", "gates", "library"]
