"""Package version: it follows the JAX package's."""

VERSION = "0.3.0"

__version__ = VERSION
