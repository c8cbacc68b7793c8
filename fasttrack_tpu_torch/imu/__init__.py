"""IMU types and preintegration (the reference's src/ImuTypes.cc); port of
fasttrack_tpu/imu."""

from fasttrack_tpu_torch.imu.preintegration import (  # noqa: F401
    GRAVITY_VALUE,
    GRAVITY,
    HostPreintegrated,
    ImuBias,
    ImuCalib,
    Preintegrated,
    preintegrate,
    integrate_measurements,
    delta_rotation,
    delta_velocity,
    delta_position,
    pack_preintegrated,
    predict_state,
    unpack_preintegrated,
)
