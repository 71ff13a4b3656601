from .builders import tip3p_water_box

__all__ = ["tip3p_water_box"]
