"""Acquisition-function builders."""
from .function import ExpectedImprovement
