from .builders import popc_bilayer, tip3p_water_box, water_droplet

__all__ = ["popc_bilayer", "tip3p_water_box", "water_droplet"]
