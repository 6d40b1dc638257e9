"""Typed configuration system (reference: src/vehicle/params); port of
``ocean_perception_tpu.config``. Reads the YAML without PyYAML."""

from .yaml_parser import YamlParser, load_opencv_yaml  # noqa: F401
from .params import ParamsBase, params  # noqa: F401
