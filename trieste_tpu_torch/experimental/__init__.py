"""Experimental features (counterpart of :mod:`trieste_tpu.experimental`)."""
