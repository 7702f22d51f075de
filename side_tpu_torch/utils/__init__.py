"""Visual debugging utilities of the port (`debugger.Debugger`)."""
