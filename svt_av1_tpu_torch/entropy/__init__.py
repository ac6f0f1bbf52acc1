from .ec import RangeEncoder, RangeDecoder, update_cdf, cdf_to_icdf, icdf_with_counter

__all__ = [
    "RangeEncoder",
    "RangeDecoder",
    "update_cdf",
    "cdf_to_icdf",
    "icdf_with_counter",
]
