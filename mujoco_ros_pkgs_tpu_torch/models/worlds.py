"""Built-in worlds (MJCF strings, no external assets), copied from
mujoco_ros_pkgs_tpu/models/worlds.py, which the port cannot import (that
package imports JAX):

  PENDULUM — ball + 2-hinge arm, free ball, static ground
  BOXES    — one free box over a ground plane (the fused-step world)
  PILE     — 12 free bodies in a walled bin (contact-rich)
  SENSORS  — a free probe with IMU sites and a rangefinder, a hinged arm
             with a force-torque site (BASELINE config 3's scene)
  ARM7     — a 7-hinge arm with 4 position servos and 3 motors, a mocap
             target and a weld from it to the last link, off at load
             (BASELINE config 4's scene)
"""

PENDULUM = """
<mujoco model="pendulum_bench">
  <option timestep="0.001" gravity="0 0 -9.81" cone="elliptic"/>
  <compiler angle="radian"/>
  <worldbody>
    <geom name="ground" type="plane" size="5 5 10"/>
    <body name="base_link">
      <geom type="capsule" fromto="0 0 1 0 0 0.6" size="0.06"/>
      <joint name="balljoint" type="ball" pos="0 0 1"/>
      <body name="middle_link">
        <geom type="capsule" fromto="0 0 0.6 0 0 0.3" size="0.04"/>
        <joint name="joint1" type="hinge" pos="0 0 0.6" axis="0 1 0"/>
        <body name="end_link">
          <geom name="EE" type="capsule" fromto="0 0 0.3 0 0 0.1" size="0.02"/>
          <joint name="joint2" type="hinge" pos="0 0 0.3" axis="0 1 0"/>
        </body>
      </body>
    </body>
    <body name="ball" pos="1 0 0.06">
      <freejoint/>
      <geom type="sphere" size="0.05" mass="0.1"/>
    </body>
  </worldbody>
</mujoco>
"""

BOXES = """
<mujoco model="boxes_bench">
  <option timestep="0.002" gravity="0 0 -9.81" cone="elliptic"/>
  <compiler angle="radian"/>
  <worldbody>
    <geom name="ground" type="plane" size="10 10 1"/>
    <body name="box" pos="0 0 0.2">
      <freejoint/>
      <geom name="box" type="box" size="0.1 0.1 0.1" mass="0.5"
            friction="1 0.005 0.0001"/>
    </body>
  </worldbody>
</mujoco>
"""

# contact-rich manipulation arena: 12 free bodies (boxes/spheres/capsules) in
# a walled bin — BASELINE config 5's scene shape (dozens of simultaneous
# contacts, ~90 collision pairs/env). Used by the contact-rich benchmark and
# the broadphase tests.
_PILE_BODIES = "\n".join(
    f"""    <body name="pb{i}" pos="{0.22*(i%4)-0.33:.2f} {0.22*(i//4)-0.22:.2f} {0.12+0.11*i:.2f}">
      <freejoint/>
      <geom name="pg{i}" type="{t}" size="{s}" mass="0.3"
            friction="0.8 0.005 0.0001"/>
    </body>"""
    for i, (t, s) in enumerate(
        [("box", "0.05 0.045 0.04"), ("sphere", "0.05"),
         ("capsule", "0.04 0.05"), ("box", "0.055 0.05 0.035"),
         ("sphere", "0.045"), ("capsule", "0.035 0.06"),
         ("box", "0.05 0.04 0.05"), ("sphere", "0.055"),
         ("box", "0.045 0.05 0.045"), ("capsule", "0.045 0.045"),
         ("sphere", "0.04"), ("box", "0.04 0.055 0.05")]))

PILE = f"""
<mujoco model="pile_bench">
  <option timestep="0.002" gravity="0 0 -9.81" cone="elliptic" iterations="12"/>
  <compiler angle="radian"/>
  <worldbody>
    <geom name="ground" type="plane" size="2 2 1"/>
    <geom name="wall_xp" type="box" pos="0.55 0 0.15" size="0.02 0.6 0.15"/>
    <geom name="wall_xm" type="box" pos="-0.55 0 0.15" size="0.02 0.6 0.15"/>
    <geom name="wall_yp" type="box" pos="0 0.55 0.15" size="0.6 0.02 0.15"/>
    <geom name="wall_ym" type="box" pos="0 -0.55 0.15" size="0.6 0.02 0.15"/>
{_PILE_BODIES}
  </worldbody>
</mujoco>
"""

SENSORS = """
<mujoco model="sensors_bench">
  <option timestep="0.001" gravity="0 0 -9.81" cone="elliptic"/>
  <compiler angle="radian"/>
  <worldbody>
    <geom name="ground" type="plane" size="5 5 1"/>
    <body name="probe" pos="0 0 0.5">
      <freejoint/>
      <geom type="box" size="0.05 0.05 0.05" mass="0.2"/>
      <site name="imu" pos="0 0 0"/>
      <site name="rf" pos="0 0 -0.05" zaxis="0 0 -1"/>
    </body>
    <body name="arm_base" pos="1 0 0.5">
      <joint name="aj" type="hinge" axis="0 1 0"/>
      <geom type="capsule" fromto="0 0 0 0 0 0.3" size="0.03"/>
      <site name="ft" pos="0 0 0.15"/>
    </body>
  </worldbody>
  <sensor>
    <accelerometer name="acc" site="imu"/>
    <velocimeter name="vel" site="imu"/>
    <gyro name="gyr" site="imu"/>
    <magnetometer name="mag" site="imu"/>
    <rangefinder name="range" site="rf"/>
    <force name="frc" site="ft"/>
    <torque name="trq" site="ft"/>
    <jointpos name="ajp" joint="aj"/>
    <jointvel name="ajv" joint="aj"/>
    <framepos name="probe_pos" objtype="xbody" objname="probe"/>
    <framequat name="probe_quat" objtype="xbody" objname="probe"/>
  </sensor>
</mujoco>
"""

ARM7 = """
<mujoco model="arm7_bench">
  <option timestep="0.002" gravity="0 0 -9.81" cone="elliptic"/>
  <compiler angle="radian"/>
  <worldbody>
    <geom name="ground" type="plane" size="5 5 1"/>
    <body name="mocap_target" mocap="true" pos="0.5 0 0.8">
      <geom type="sphere" size="0.02" contype="0" conaffinity="0"/>
    </body>
    <body name="link0" pos="0 0 0.1">
      <geom type="capsule" fromto="0 0 0 0 0 0.2" size="0.05"/>
      <joint name="j0" type="hinge" axis="0 0 1" range="-3 3" damping="1" armature="0.1"/>
      <body name="link1" pos="0 0 0.2">
        <geom type="capsule" fromto="0 0 0 0 0 0.2" size="0.045"/>
        <joint name="j1" type="hinge" axis="0 1 0" range="-2 2" damping="1" armature="0.1"/>
        <body name="link2" pos="0 0 0.2">
          <geom type="capsule" fromto="0 0 0 0 0 0.2" size="0.04"/>
          <joint name="j2" type="hinge" axis="0 0 1" range="-3 3" damping="1" armature="0.1"/>
          <body name="link3" pos="0 0 0.2">
            <geom type="capsule" fromto="0 0 0 0 0 0.2" size="0.035"/>
            <joint name="j3" type="hinge" axis="0 1 0" range="-2 2" damping="1" armature="0.1"/>
            <body name="link4" pos="0 0 0.2">
              <geom type="capsule" fromto="0 0 0 0 0 0.15" size="0.03"/>
              <joint name="j4" type="hinge" axis="0 0 1" range="-3 3" damping="0.5" armature="0.05"/>
              <body name="link5" pos="0 0 0.15">
                <geom type="capsule" fromto="0 0 0 0 0 0.15" size="0.025"/>
                <joint name="j5" type="hinge" axis="0 1 0" range="-2 2" damping="0.5" armature="0.05"/>
                <body name="link6" pos="0 0 0.15">
                  <geom name="ee" type="capsule" fromto="0 0 0 0 0 0.1" size="0.02"/>
                  <joint name="j6" type="hinge" axis="0 0 1" range="-3 3" damping="0.5" armature="0.05"/>
                  <site name="ee_site" pos="0 0 0.1"/>
                </body>
              </body>
            </body>
          </body>
        </body>
      </body>
    </body>
  </worldbody>
  <equality>
    <weld name="ee_target" body1="mocap_target" body2="link6"
          solref="0.02 1" active="false"/>
  </equality>
  <actuator>
    <position name="p0" joint="j0" kp="40" kv="4" ctrlrange="-3 3"/>
    <position name="p1" joint="j1" kp="40" kv="4" ctrlrange="-2 2"/>
    <position name="p2" joint="j2" kp="30" kv="3" ctrlrange="-3 3"/>
    <position name="p3" joint="j3" kp="30" kv="3" ctrlrange="-2 2"/>
    <motor name="m4" joint="j4" ctrlrange="-20 20"/>
    <motor name="m5" joint="j5" ctrlrange="-20 20"/>
    <motor name="m6" joint="j6" ctrlrange="-10 10"/>
  </actuator>
</mujoco>
"""
