// A1 robot interface: UDP transport + safety clamp, C ABI for ctypes.
//
// TPU-native counterpart of the reference's pybind11 robot_interface
// (reference: third_party/unitree_legged_sdk/python_interface.cpp:17-100):
// same ReceiveObservation/SendCommand surface (12 motors x 5 command
// params = 60 floats; low-state observation vector) over UDP, with a
// C++-side safety layer that clamps joint position targets, gains, and
// torques to hardware limits before anything reaches the wire.
//
// Two wire formats, selected at a1_create time (wire_mode):
//
//   0 = framework packet (compact, used by the loopback simulator/bridge):
//     command:     tag 'C1A1' + 60 f32 (q, dq, kp, kd, tau) x 12 motors
//     observation: tag 'O1A1' + 50 f32
//       [q[12], dq[12], tau_est[12], quat[4], gyro[3], accel[3], foot[4]]
//
//   1 = Unitree vendor format: byte-exact #pragma pack(1) LowCmd/LowState
//     structs from the vendor SDK (reference:
//     include/unitree_legged_sdk/comm.h:61-99) with the vendor's CRC32
//     (the crc32_core routine published in Unitree's open examples), so
//     the driver talks to a real A1 out of the box with no bridge
//     (reference capability: python_interface.cpp:17-100).
//
// The Python-facing surface is identical in both modes: 60-float command
// in, 50-float observation out.
//
// Build: g++ -O2 -shared -fPIC -o librobot_interface.so robot_interface.cpp

#include <arpa/inet.h>
#include <cstdint>
#include <cstring>
#include <netinet/in.h>
#include <sys/socket.h>
#include <sys/time.h>
#include <unistd.h>

#include <algorithm>
#include <cmath>

namespace {

constexpr int kNumMotors = 12;
constexpr int kCmdFloats = 60;   // 5 per motor.
constexpr int kObsFloats = 50;
constexpr uint32_t kCmdTag = 0x43314131;  // 'C1A1'
constexpr uint32_t kObsTag = 0x4F314131;  // 'O1A1'

// Public A1 joint limits (hip, thigh, calf) repeated per leg, radians.
constexpr float kPosLow[3] = {-0.802f, -1.05f, -2.70f};
constexpr float kPosHigh[3] = {0.802f, 4.19f, -0.916f};
constexpr float kMaxTorque = 33.5f;   // Nm, A1 motor peak.
constexpr float kMaxVelocity = 21.0f; // rad/s.
constexpr float kMaxKp = 100.0f;
constexpr float kMaxKd = 8.0f;

// ---- Unitree vendor wire structs (byte-exact, comm.h:20-99) ----------------

#pragma pack(push, 1)

struct VendorIMU {
  float quaternion[4];
  float gyroscope[3];
  float accelerometer[3];
  float rpy[3];
  int8_t temperature;
};

struct VendorMotorState {
  uint8_t mode;
  float q, dq, ddq, tauEst, q_raw, dq_raw, ddq_raw;
  int8_t temperature;
  uint32_t reserve[2];
};

struct VendorMotorCmd {
  uint8_t mode;
  float q, dq, tau, Kp, Kd;
  uint32_t reserve[3];
};

struct VendorLED {
  uint8_t r, g, b;
};

struct VendorLowState {
  uint8_t levelFlag;
  uint16_t commVersion;
  uint16_t robotID;
  uint32_t SN;
  uint8_t bandWidth;
  VendorIMU imu;
  VendorMotorState motorState[20];
  int16_t footForce[4];
  int16_t footForceEst[4];
  uint32_t tick;
  uint8_t wirelessRemote[40];
  uint32_t reserve;
  uint32_t crc;
};

struct VendorLowCmd {
  uint8_t levelFlag;
  uint16_t commVersion;
  uint16_t robotID;
  uint32_t SN;
  uint8_t bandWidth;
  VendorMotorCmd motorCmd[20];
  VendorLED led[4];
  uint8_t wirelessRemote[40];
  uint32_t reserve;
  uint32_t crc;
};

#pragma pack(pop)

static_assert(sizeof(VendorMotorCmd) == 33, "packed layout");
static_assert(sizeof(VendorMotorState) == 38, "packed layout");
static_assert(sizeof(VendorLowCmd) == 10 + 20 * 33 + 12 + 40 + 8,
              "packed layout");
static_assert(sizeof(VendorLowState) == 10 + 53 + 20 * 38 + 16 + 4 + 40 + 8,
              "packed layout");

constexpr uint8_t kLowLevel = 0xff;   // comm.h: LOWLEVEL
constexpr uint8_t kServoMode = 0x0A;  // Motor servo mode (vendor examples).

// Vendor CRC (crc32_core from Unitree's open SDK examples): bitwise
// CRC-32/MPEG-2-style over the packet's leading 32-bit words, excluding
// the trailing crc field itself.
uint32_t vendor_crc32(const uint32_t* ptr, uint32_t len) {
  uint32_t crc = 0xFFFFFFFF;
  const uint32_t poly = 0x04c11db7;
  for (uint32_t i = 0; i < len; i++) {
    uint32_t xbit = 1u << 31;
    const uint32_t data = ptr[i];
    for (uint32_t bits = 0; bits < 32; bits++) {
      if (crc & 0x80000000u) {
        crc <<= 1;
        crc ^= poly;
      } else {
        crc <<= 1;
      }
      if (data & xbit) crc ^= poly;
      xbit >>= 1;
    }
  }
  return crc;
}

struct Handle {
  int fd = -1;
  sockaddr_in remote{};
  float power_protect = 1.0f;  // Fraction of torque limit allowed.
  int wire_mode = 0;           // 0 = framework packet, 1 = vendor structs.
  uint64_t sent = 0;
  uint64_t received = 0;
  uint64_t clamped = 0;
  uint64_t crc_errors = 0;
};

float clampf(float v, float lo, float hi) {
  return std::max(lo, std::min(hi, v));
}

}  // namespace

extern "C" {

// Create a UDP endpoint bound to local_port, targeting ip:remote_port.
// wire_mode: 0 = framework packet, 1 = Unitree vendor LowCmd/LowState.
void* a1_create_wire(const char* ip, int local_port, int remote_port,
                     int recv_timeout_ms, int wire_mode) {
  Handle* h = new Handle();
  h->wire_mode = wire_mode;
  h->fd = socket(AF_INET, SOCK_DGRAM, 0);
  if (h->fd < 0) {
    delete h;
    return nullptr;
  }
  int reuse = 1;
  setsockopt(h->fd, SOL_SOCKET, SO_REUSEADDR, &reuse, sizeof(reuse));
  timeval tv{};
  tv.tv_sec = recv_timeout_ms / 1000;
  tv.tv_usec = (recv_timeout_ms % 1000) * 1000;
  setsockopt(h->fd, SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof(tv));
  sockaddr_in local{};
  local.sin_family = AF_INET;
  local.sin_addr.s_addr = INADDR_ANY;
  local.sin_port = htons(static_cast<uint16_t>(local_port));
  if (bind(h->fd, reinterpret_cast<sockaddr*>(&local), sizeof(local)) < 0) {
    close(h->fd);
    delete h;
    return nullptr;
  }
  h->remote.sin_family = AF_INET;
  h->remote.sin_port = htons(static_cast<uint16_t>(remote_port));
  inet_pton(AF_INET, ip, &h->remote.sin_addr);
  return h;
}

void* a1_create(const char* ip, int local_port, int remote_port,
                int recv_timeout_ms) {
  return a1_create_wire(ip, local_port, remote_port, recv_timeout_ms, 0);
}

void a1_set_power_protect(void* handle, float fraction) {
  Handle* h = static_cast<Handle*>(handle);
  h->power_protect = clampf(fraction, 0.0f, 1.0f);
}

// Safety clamp (in place): position targets to joint limits, gains and
// torques to hardware bounds scaled by the power-protect level.
void a1_safety_clamp(void* handle, float* cmd) {
  Handle* h = static_cast<Handle*>(handle);
  for (int m = 0; m < kNumMotors; ++m) {
    float* c = cmd + 5 * m;
    // Reject non-finite commands outright: freeze the motor (zero gains
    // and torque) instead of letting NaNs reach the clamp (where IEEE
    // comparisons would silently turn them into limit values).
    bool finite = true;
    for (int i = 0; i < 5; ++i) {
      if (!std::isfinite(c[i])) finite = false;
    }
    if (!finite) {
      const int joint = m % 3;
      c[0] = clampf(std::isfinite(c[0]) ? c[0] : 0.0f,
                    kPosLow[joint], kPosHigh[joint]);
      c[1] = 0.0f;
      c[2] = 0.0f;
      c[3] = 0.0f;
      c[4] = 0.0f;
      h->clamped += 1;
      continue;
    }
    const int joint = m % 3;
    const float q = clampf(c[0], kPosLow[joint], kPosHigh[joint]);
    const float dq = clampf(c[1], -kMaxVelocity, kMaxVelocity);
    const float kp = clampf(c[2], 0.0f, kMaxKp);
    const float kd = clampf(c[3], 0.0f, kMaxKd);
    const float tmax = kMaxTorque * h->power_protect;
    const float tau = clampf(c[4], -tmax, tmax);
    if (q != c[0] || tau != c[4]) {
      h->clamped += 1;
    }
    c[0] = q;
    c[1] = dq;
    c[2] = kp;
    c[3] = kd;
    c[4] = tau;
  }
}

// Serialize a clamped 60-float command into a vendor LowCmd packet.
// Exposed separately so tests can check byte-exactness without a socket.
int a1_pack_lowcmd(float* cmd, char* out) {
  VendorLowCmd pkt{};
  pkt.levelFlag = kLowLevel;
  for (int m = 0; m < kNumMotors; ++m) {
    const float* c = cmd + 5 * m;
    VendorMotorCmd& mc = pkt.motorCmd[m];
    mc.mode = kServoMode;
    mc.q = c[0];
    mc.dq = c[1];
    mc.Kp = c[2];
    mc.Kd = c[3];
    mc.tau = c[4];
  }
  // Unused motor slots (12..19): position-stop / velocity-stop sentinels,
  // matching the vendor examples' initialization.
  for (int m = kNumMotors; m < 20; ++m) {
    VendorMotorCmd& mc = pkt.motorCmd[m];
    mc.mode = kServoMode;
    mc.q = 2.146e9f;   // PosStopF (comm.h:17)
    mc.dq = 16000.0f;  // VelStopF (comm.h:18)
  }
  // Vendor CRC convention: over the leading (size>>2)-1 32-bit words,
  // stored in the trailing 4 bytes (both unaligned relative to the
  // packed layout, exactly as the vendor examples compute it).
  char buf[sizeof(VendorLowCmd)];
  std::memcpy(buf, &pkt, sizeof(pkt));
  const uint32_t words = (sizeof(VendorLowCmd) >> 2) - 1;
  uint32_t tmp[sizeof(VendorLowCmd) / 4];
  std::memcpy(tmp, buf, words * 4);
  const uint32_t crc = vendor_crc32(tmp, words);
  std::memcpy(buf + sizeof(VendorLowCmd) - 4, &crc, 4);
  std::memcpy(out, buf, sizeof(VendorLowCmd));
  return static_cast<int>(sizeof(VendorLowCmd));
}

// Clamp and send one command packet. Returns bytes sent or -1.
int a1_send_command(void* handle, float* cmd) {
  Handle* h = static_cast<Handle*>(handle);
  a1_safety_clamp(handle, cmd);
  ssize_t n;
  if (h->wire_mode == 1) {
    char packet[sizeof(VendorLowCmd)];
    a1_pack_lowcmd(cmd, packet);
    n = sendto(h->fd, packet, sizeof(packet), 0,
               reinterpret_cast<sockaddr*>(&h->remote), sizeof(h->remote));
  } else {
    char packet[4 + kCmdFloats * sizeof(float)];
    uint32_t tag = kCmdTag;
    std::memcpy(packet, &tag, 4);
    std::memcpy(packet + 4, cmd, kCmdFloats * sizeof(float));
    n = sendto(h->fd, packet, sizeof(packet), 0,
               reinterpret_cast<sockaddr*>(&h->remote), sizeof(h->remote));
  }
  if (n > 0) h->sent += 1;
  return static_cast<int>(n);
}

// Parse a vendor LowState packet into the 50-float observation vector.
// Returns 1 on success, -1 on CRC/size mismatch.
int a1_parse_lowstate(const char* buf, int len, float* obs) {
  if (len != static_cast<int>(sizeof(VendorLowState))) return -1;
  const uint32_t words = (sizeof(VendorLowState) >> 2) - 1;
  uint32_t tmp[sizeof(VendorLowState) / 4];
  std::memcpy(tmp, buf, words * 4);
  uint32_t crc = 0;
  std::memcpy(&crc, buf + sizeof(VendorLowState) - 4, 4);
  if (vendor_crc32(tmp, words) != crc) return -1;
  VendorLowState st;
  std::memcpy(&st, buf, sizeof(st));
  for (int m = 0; m < kNumMotors; ++m) {
    obs[m] = st.motorState[m].q;
    obs[12 + m] = st.motorState[m].dq;
    obs[24 + m] = st.motorState[m].tauEst;
  }
  for (int i = 0; i < 4; ++i) obs[36 + i] = st.imu.quaternion[i];
  for (int i = 0; i < 3; ++i) obs[40 + i] = st.imu.gyroscope[i];
  for (int i = 0; i < 3; ++i) obs[43 + i] = st.imu.accelerometer[i];
  for (int i = 0; i < 4; ++i) {
    obs[46 + i] = static_cast<float>(st.footForce[i]);
  }
  return 1;
}

// Serialize a 50-float observation into a vendor LowState packet (used by
// the loopback robot simulator in tests and the robot-side bridge).
int a1_pack_lowstate(const float* obs, char* out) {
  VendorLowState st{};
  st.levelFlag = kLowLevel;
  for (int m = 0; m < kNumMotors; ++m) {
    st.motorState[m].mode = kServoMode;
    st.motorState[m].q = obs[m];
    st.motorState[m].dq = obs[12 + m];
    st.motorState[m].tauEst = obs[24 + m];
  }
  for (int i = 0; i < 4; ++i) st.imu.quaternion[i] = obs[36 + i];
  for (int i = 0; i < 3; ++i) st.imu.gyroscope[i] = obs[40 + i];
  for (int i = 0; i < 3; ++i) st.imu.accelerometer[i] = obs[43 + i];
  for (int i = 0; i < 4; ++i) {
    st.footForce[i] = static_cast<int16_t>(obs[46 + i]);
  }
  char buf[sizeof(VendorLowState)];
  std::memcpy(buf, &st, sizeof(st));
  const uint32_t words = (sizeof(VendorLowState) >> 2) - 1;
  uint32_t tmp[sizeof(VendorLowState) / 4];
  std::memcpy(tmp, buf, words * 4);
  const uint32_t crc = vendor_crc32(tmp, words);
  std::memcpy(buf + sizeof(VendorLowState) - 4, &crc, 4);
  std::memcpy(out, buf, sizeof(VendorLowState));
  return static_cast<int>(sizeof(VendorLowState));
}

// Blocking receive of one 50-float observation. Returns 1 on success,
// 0 on timeout, -1 on error or malformed packet.
int a1_receive_observation(void* handle, float* obs) {
  Handle* h = static_cast<Handle*>(handle);
  if (h->wire_mode == 1) {
    char packet[sizeof(VendorLowState)];
    ssize_t n = recv(h->fd, packet, sizeof(packet), 0);
    if (n < 0) return 0;  // Timeout.
    if (a1_parse_lowstate(packet, static_cast<int>(n), obs) != 1) {
      h->crc_errors += 1;
      return -1;
    }
    h->received += 1;
    return 1;
  }
  char packet[4 + kObsFloats * sizeof(float)];
  ssize_t n = recv(h->fd, packet, sizeof(packet), 0);
  if (n < 0) {
    return 0;  // Timeout.
  }
  if (n != static_cast<ssize_t>(sizeof(packet))) {
    return -1;
  }
  uint32_t tag = 0;
  std::memcpy(&tag, packet, 4);
  if (tag != kObsTag) {
    return -1;
  }
  std::memcpy(obs, packet + 4, kObsFloats * sizeof(float));
  h->received += 1;
  return 1;
}

void a1_stats(void* handle, uint64_t* sent, uint64_t* received,
              uint64_t* clamped) {
  Handle* h = static_cast<Handle*>(handle);
  *sent = h->sent;
  *received = h->received;
  *clamped = h->clamped;
}

void a1_destroy(void* handle) {
  Handle* h = static_cast<Handle*>(handle);
  if (h->fd >= 0) close(h->fd);
  delete h;
}

}  // extern "C"
