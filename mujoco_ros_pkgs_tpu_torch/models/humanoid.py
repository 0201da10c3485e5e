"""Humanoid world: 27-dof biped — the classic RL-scale benchmark family.

Copied from mujoco_ros_pkgs_tpu/models/humanoid.py, which the port does not
import (it keeps its own copies of the JAX package's worlds): a free root,
21 limited hinges with damping, 21 torque motors, capsule, sphere and box
limbs on a plane, elliptic contacts; iterations 20, ls_iterations 10.
"""

HUMANOID = """
<mujoco model="humanoid_bench">
  <option timestep="0.003" gravity="0 0 -9.81" cone="elliptic"
          iterations="20" ls_iterations="10"/>
  <compiler angle="radian"/>
  <default>
    <joint damping="1" armature="0.02" limited="true"/>
    <geom friction="0.9 0.005 0.0001" condim="3"/>
    <motor ctrlrange="-1 1" gear="40"/>
  </default>
  <worldbody>
    <geom name="floor" type="plane" size="20 20 1"/>
    <body name="torso" pos="0 0 1.3">
      <freejoint name="root"/>
      <geom name="torso_geom" type="capsule" fromto="0 -0.07 0 0 0.07 0" size="0.07"/>
      <geom name="head" type="sphere" pos="0 0 0.19" size="0.09"/>
      <body name="lower_torso" pos="0 0 -0.2">
        <joint name="abdomen_z" type="hinge" axis="0 0 1" range="-0.7 0.7"/>
        <joint name="abdomen_y" type="hinge" axis="0 1 0" range="-1.0 0.5"/>
        <geom type="capsule" fromto="0 -0.06 0 0 0.06 0" size="0.06"/>
        <body name="pelvis" pos="0 0 -0.15">
          <joint name="abdomen_x" type="hinge" axis="1 0 0" range="-0.6 0.6"/>
          <geom type="capsule" fromto="0 -0.07 0 0 0.07 0" size="0.07"/>
          <body name="right_thigh" pos="0 -0.1 -0.04">
            <joint name="right_hip_x" type="hinge" axis="1 0 0" range="-0.4 0.1"/>
            <joint name="right_hip_z" type="hinge" axis="0 0 1" range="-1.0 0.6"/>
            <joint name="right_hip_y" type="hinge" axis="0 1 0" range="-1.9 0.7"/>
            <geom type="capsule" fromto="0 0 0 0 0 -0.34" size="0.055"/>
            <body name="right_shin" pos="0 0 -0.4">
              <joint name="right_knee" type="hinge" axis="0 1 0" range="-2.6 -0.02"/>
              <geom type="capsule" fromto="0 0 0 0 0 -0.3" size="0.045"/>
              <body name="right_foot" pos="0 0 -0.35">
                <joint name="right_ankle_y" type="hinge" axis="0 1 0" range="-0.9 0.7"/>
                <joint name="right_ankle_x" type="hinge" axis="1 0 0" range="-0.5 0.5"/>
                <geom name="right_foot_geom" type="box" pos="0.045 0 -0.0275"
                      size="0.0885 0.045 0.0275"/>
              </body>
            </body>
          </body>
          <body name="left_thigh" pos="0 0.1 -0.04">
            <joint name="left_hip_x" type="hinge" axis="1 0 0" range="-0.1 0.4"/>
            <joint name="left_hip_z" type="hinge" axis="0 0 1" range="-0.6 1.0"/>
            <joint name="left_hip_y" type="hinge" axis="0 1 0" range="-1.9 0.7"/>
            <geom type="capsule" fromto="0 0 0 0 0 -0.34" size="0.055"/>
            <body name="left_shin" pos="0 0 -0.4">
              <joint name="left_knee" type="hinge" axis="0 1 0" range="-2.6 -0.02"/>
              <geom type="capsule" fromto="0 0 0 0 0 -0.3" size="0.045"/>
              <body name="left_foot" pos="0 0 -0.35">
                <joint name="left_ankle_y" type="hinge" axis="0 1 0" range="-0.9 0.7"/>
                <joint name="left_ankle_x" type="hinge" axis="1 0 0" range="-0.5 0.5"/>
                <geom name="left_foot_geom" type="box" pos="0.045 0 -0.0275"
                      size="0.0885 0.045 0.0275"/>
              </body>
            </body>
          </body>
        </body>
      </body>
      <body name="right_upper_arm" pos="0 -0.17 0.06">
        <joint name="right_shoulder1" type="hinge" axis="2 1 1" range="-1.5 1.0"/>
        <joint name="right_shoulder2" type="hinge" axis="0 -1 1" range="-1.5 1.0"/>
        <geom type="capsule" fromto="0 0 0 0.16 -0.16 -0.16" size="0.04"/>
        <body name="right_lower_arm" pos="0.18 -0.18 -0.18">
          <joint name="right_elbow" type="hinge" axis="0 -1 1" range="-1.6 0.5"/>
          <geom type="capsule" fromto="0 0 0 0.16 0.16 0.16" size="0.031"/>
        </body>
      </body>
      <body name="left_upper_arm" pos="0 0.17 0.06">
        <joint name="left_shoulder1" type="hinge" axis="2 -1 1" range="-1.0 1.5"/>
        <joint name="left_shoulder2" type="hinge" axis="0 1 1" range="-1.0 1.5"/>
        <geom type="capsule" fromto="0 0 0 0.16 0.16 -0.16" size="0.04"/>
        <body name="left_lower_arm" pos="0.18 0.18 -0.18">
          <joint name="left_elbow" type="hinge" axis="0 -1 -1" range="-1.6 0.5"/>
          <geom type="capsule" fromto="0 0 0 0.16 -0.16 0.16" size="0.031"/>
        </body>
      </body>
    </body>
  </worldbody>
  <actuator>
    <motor joint="abdomen_z" gear="40"/>
    <motor joint="abdomen_y" gear="40"/>
    <motor joint="abdomen_x" gear="40"/>
    <motor joint="right_hip_x" gear="40"/>
    <motor joint="right_hip_z" gear="40"/>
    <motor joint="right_hip_y" gear="120"/>
    <motor joint="right_knee" gear="80"/>
    <motor joint="right_ankle_y" gear="20"/>
    <motor joint="right_ankle_x" gear="20"/>
    <motor joint="left_hip_x" gear="40"/>
    <motor joint="left_hip_z" gear="40"/>
    <motor joint="left_hip_y" gear="120"/>
    <motor joint="left_knee" gear="80"/>
    <motor joint="left_ankle_y" gear="20"/>
    <motor joint="left_ankle_x" gear="20"/>
    <motor joint="right_shoulder1" gear="20"/>
    <motor joint="right_shoulder2" gear="20"/>
    <motor joint="right_elbow" gear="40"/>
    <motor joint="left_shoulder1" gear="20"/>
    <motor joint="left_shoulder2" gear="20"/>
    <motor joint="left_elbow" gear="40"/>
  </actuator>
</mujoco>
"""
