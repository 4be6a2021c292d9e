from .safetensors_reader import SafetensorsFile, load_safetensors  # noqa: F401
