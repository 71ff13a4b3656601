"""Version info (counterpart of openmm_tpu/version.py)."""
short_version = "0.1.0"
version = "openmm-tpu-torch 0.1.0"
full_version = version
git_revision = "unknown"
openmm_library_path = ""
