from .builders import popc_bilayer, tip3p_water_box

__all__ = ["popc_bilayer", "tip3p_water_box"]
