from . import ast
from .lexer import Token, tokenize
from .parser import parse, parse_one

__all__ = ["ast", "Token", "tokenize", "parse", "parse_one"]
