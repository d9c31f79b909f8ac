"""World-editor tools of the port (scx.tools): the editor core, the asset
database and the terminal editor session (editor_app)."""

from scx_torch.tools.editor import (
    EditorDocument,
    EditorEntity,
    CommandStack,
    PlaceCommand,
    DeleteCommand,
    TransformCommand,
    SetPropertyCommand,
    pick_entity,
    make_pick_ray,
    FlyCamera,
    translate_gizmo_drag,
)
from scx_torch.tools.asset_db import AssetDatabase, AssetKind
