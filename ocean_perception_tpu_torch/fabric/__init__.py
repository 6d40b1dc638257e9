"""Host process fabric: pub/sub messaging + zero-copy image transport (port
of ``ocean_perception_tpu.fabric``).

Reference parity: the reference connects its processes with LCM (UDP
multicast pub/sub with IDL-generated types, README.md:63-67) plus an
out-of-band shared-memory mmap transport for images (mmf_image_t;
lcm_util/image_subscriber.hpp:29-72) so frames never serialize.

``pubsub`` is a UDP-multicast bus with the same channel semantics (plus an
in-process loopback for single-process pipelines); ``messages`` defines
binary-packed message types covering the reference's lcmtypes;
``lcm_wire`` speaks the LCM wire format itself; the image path uses
``shm_ring``, a native lock-free single-producer ring buffer over shared
memory (ctypes-bound); ``native_bus`` is the C++ UDP transport and
``chaos`` a seeded fault-injecting wrapper for any bus. None of it needs
OpenCV except the JPEG images.
"""

from .messages import (  # noqa: F401
    ImageMessage,
    StereoImageMessage,
    ImuMessage,
    DepthMessage,
    RangeMessage,
    MagMessage,
    PoseStampedMessage,
    MeshMessage,
    ShmImageHeader,
    encode_message,
    decode_message,
)
from .pubsub import PubSub, InProcessBus, UdpMulticastBus  # noqa: F401
from .native_bus import NativeUdpBus  # noqa: F401
from .chaos import ChaosBus  # noqa: F401
from .shm_ring import ShmRingWriter, ShmRingReader, native_available  # noqa: F401
