from .builders import (popc_bilayer, popc_obc_cluster, tip3p_water_box,
                       tip4pew_water_box, water_droplet)

__all__ = ["popc_bilayer", "popc_obc_cluster", "tip3p_water_box",
           "tip4pew_water_box", "water_droplet"]
