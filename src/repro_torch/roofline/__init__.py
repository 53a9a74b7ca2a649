from .analysis import (collective_bytes, roofline_terms, parse_hlo_collectives,
                       HW, model_flops)

__all__ = ["collective_bytes", "roofline_terms", "parse_hlo_collectives",
           "HW", "model_flops"]
