"""The general traffic loads: a mix names one (``load``)."""
